"""Force-generate a dataset locally (the twin of create_dataset.py):

    python -m kmb_tpu_torch.create_dataset --dataset NAME [--hardware CPU]

Writes `data/NAME.hdf5` (or under KMB_DATA_DIR) in the repository's layout,
overwriting an existing file.  The float64 truth is computed on the card,
or on the CPU with `--hardware CPU`.
"""

from __future__ import annotations

import argparse

from kmb_tpu_torch.datasets import (
    DATASETS, get_dataset_fn, ground_truth, make_arrays, write_output)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m kmb_tpu_torch.create_dataset")
    parser.add_argument("--dataset", choices=DATASETS.keys(), required=True)
    parser.add_argument(
        "--hardware", default="GPU", choices=["CPU", "GPU"],
        help="where the float64 truth is computed")
    args = parser.parse_args(argv)
    arrays = make_arrays(args.dataset)
    truth = ground_truth(
        arrays, device="cuda" if args.hardware == "GPU" else "cpu")
    fn = get_dataset_fn(args.dataset)
    write_output(fn, arrays, truth)
    print(f"Wrote {fn}")
    return fn


if __name__ == "__main__":
    main()
