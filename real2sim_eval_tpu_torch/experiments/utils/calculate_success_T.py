"""T-push success over saved rollouts
(the JAX package's experiments/utils/calculate_success_T.py). Requires the target
particle state pkl (the reference ships T_final_state.pkl)."""

import argparse

from .success import (evaluate_episodes, is_pusht_success, load_state,
                      write_success_file, _np)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--target_state", type=str, required=True,
                        help="pkl with renderer.x of the goal configuration")
    parser.add_argument("--start_step", type=int, default=1700)
    args = parser.parse_args(argv)

    target = load_state(args.target_state)
    x_target = _np(target["renderer"]["x"])

    results = evaluate_episodes(
        args.data_dir,
        lambda state, init: is_pusht_success(state, x_target, init),
        start_step=args.start_step)
    print("pusht success list:", results)
    write_success_file(args.data_dir, results, "pusht")
    return results


if __name__ == "__main__":
    main()
