"""CLI entry point, mirroring main.py's flag surface and flow.

Usage:
    python -m stemgnn_tpu_torch --dataset ECG_data --train False

Runs `engine.test` on the card (or on the CPU with --device cpu): restore
the best checkpoint from <output_dir>/<dataset>/train and evaluate the test
split. Training (--train True) is not ported yet and raises.
"""

import argparse
import os
from datetime import datetime

from stemgnn_tpu_torch.config import add_cli_args, config_from_args
from stemgnn_tpu_torch.data import ensure_dataset, load_csv, split_by_ratio
from stemgnn_tpu_torch.train.engine import test


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m stemgnn_tpu_torch")
    add_cli_args(parser)
    cfg = config_from_args(parser.parse_args(argv))
    print(f"Training configs: {cfg}")
    if cfg.train:
        raise NotImplementedError(
            "training is not ported yet; run with --train False to evaluate "
            "a saved checkpoint")
    data_file = ensure_dataset(cfg.dataset, cfg.data_dir)
    result_train_file = os.path.join(cfg.output_dir, cfg.dataset, "train")
    result_test_file = os.path.join(cfg.output_dir, cfg.dataset, "test")
    os.makedirs(result_test_file, exist_ok=True)
    data = load_csv(data_file)
    _, _, test_data = split_by_ratio(
        data, cfg.train_length, cfg.valid_length, cfg.test_length)
    if cfg.evaluate:
        before_evaluation = datetime.now().timestamp()
        test(test_data, cfg, result_train_file, result_test_file)
        after_evaluation = datetime.now().timestamp()
        print(f"Evaluation took {(after_evaluation - before_evaluation) / 60} minutes")
    print("done")


if __name__ == "__main__":
    main()
