"""Rope-routing success over saved rollouts
(the JAX package's experiments/utils/calculate_success_rope.py)."""

import argparse

from .success import evaluate_episodes, is_rope_success, write_success_file


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--start_step", type=int, default=800,
                        help="last-100-frames window of a 900-step episode")
    args = parser.parse_args(argv)
    results = evaluate_episodes(args.data_dir, is_rope_success,
                                start_step=args.start_step)
    print("insert_rope success list:", results)
    write_success_file(args.data_dir, results, "insert_rope")
    return results


if __name__ == "__main__":
    main()
