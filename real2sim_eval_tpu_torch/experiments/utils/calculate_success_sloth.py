"""Sloth-packing success over saved rollouts
(the JAX package's experiments/utils/calculate_success_sloth.py)."""

import argparse

from .success import evaluate_episodes, is_sloth_success, write_success_file


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--start_step", type=int, default=350,
                        help="last-100-frames window of a 450-step episode")
    args = parser.parse_args(argv)
    results = evaluate_episodes(args.data_dir, is_sloth_success,
                                start_step=args.start_step)
    print("pack_sloth success list:", results)
    write_success_file(args.data_dir, results, "pack_sloth")
    return results


if __name__ == "__main__":
    main()
