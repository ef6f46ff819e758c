"""CLI entry point, mirroring main.py's flag surface and flow.

Usage:
    python -m stemgnn_tpu_torch --dataset ECG_data --epoch 1
    python -m stemgnn_tpu_torch --dataset ECG_data --train False
    python -m stemgnn_tpu_torch --dataset ECG_data --sparse_k 16 --gru_hidden 32 --gru_segment 35

The last trains the stretch path (a top-k sparse latent graph and a GRU of
32 hidden units over segments of 35 nodes; stemgnn_tpu_torch/ops/sparse.py).

On several processes, one card each, torchrun starts them and the mesh
flags lay them out (stemgnn_tpu_torch/parallel/mesh.py):

    torchrun --nproc_per_node 2 -m stemgnn_tpu_torch --dataset ECG_data --data_axis 2
    torchrun --nproc_per_node 4 -m stemgnn_tpu_torch --dataset ECG_data \
        --sparse_k 16 --gru_hidden 32 --gru_segment 35 --data_axis 2 --graph_axis 2
    torchrun --nproc_per_node 4 -m stemgnn_tpu_torch --dataset ECG_data \
        --data_axis 2 --graph_axis 2
    torchrun --nproc_per_node 4 -m stemgnn_tpu_torch --dataset ECG_data \
        --graph_axis 4 --use_ring True

The last two partition the dense model's nodes over 'graph' (each rank its
rows of the attention and of the Chebyshev stack), the last with the
attention on the ring. Each rank initialises the process group (NCCL on the
card, gloo with --device cpu) from torchrun's environment; rank 0 writes the
files.

Runs on the card, or on the CPU with --device cpu. With --train True (the
default) `engine.train` trains and validates, writing norm_stat.json, the
per-epoch and best checkpoints and metrics.jsonl into
<output_dir>/<dataset>/train; then, with --evaluate True, `engine.test`
restores the best checkpoint from there and evaluates the test split into
<output_dir>/<dataset>/test.
"""

import argparse
import os
from datetime import datetime

import torch.distributed as dist

from stemgnn_tpu_torch.config import add_cli_args, config_from_args
from stemgnn_tpu_torch.data import ensure_dataset, load_csv, split_by_ratio
from stemgnn_tpu_torch.parallel.mesh import init_distributed, is_lead
from stemgnn_tpu_torch.train.engine import test, train


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m stemgnn_tpu_torch")
    add_cli_args(parser)
    cfg = config_from_args(parser.parse_args(argv))
    print(f"Training configs: {cfg}")
    if cfg.data_axis * cfg.graph_axis > 1 or "WORLD_SIZE" in os.environ:
        init_distributed(cfg.device)
    try:
        _run(cfg)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _run(cfg):
    # the lead rank synthesizes a missing dataset; the others wait for it
    data_file = ensure_dataset(cfg.dataset, cfg.data_dir) if is_lead() else None
    if dist.is_initialized():
        dist.barrier()
    data_file = data_file or ensure_dataset(cfg.dataset, cfg.data_dir)
    result_train_file = os.path.join(cfg.output_dir, cfg.dataset, "train")
    result_test_file = os.path.join(cfg.output_dir, cfg.dataset, "test")
    os.makedirs(result_train_file, exist_ok=True)
    os.makedirs(result_test_file, exist_ok=True)
    data = load_csv(data_file)
    train_data, valid_data, test_data = split_by_ratio(
        data, cfg.train_length, cfg.valid_length, cfg.test_length)
    if cfg.train:
        try:
            before_train = datetime.now().timestamp()
            train(train_data, valid_data, cfg, result_train_file)
            after_train = datetime.now().timestamp()
            print(f"Training took {(after_train - before_train) / 60} minutes")
        except KeyboardInterrupt:
            print("-" * 99)
            print("Exiting from training early")
    if cfg.evaluate:
        before_evaluation = datetime.now().timestamp()
        test(test_data, cfg, result_train_file, result_test_file)
        after_evaluation = datetime.now().timestamp()
        print(f"Evaluation took {(after_evaluation - before_evaluation) / 60} minutes")
    print("done")


if __name__ == "__main__":
    main()
