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

Across hosts, one torchrun a host, each given the first host's address and
a free port on it (RANK and LOCAL_RANK then differ on the second host; a
rank takes card LOCAL_RANK):

    torchrun --nnodes 2 --node_rank 0 --nproc_per_node 8 \
        --master_addr HOST0 --master_port 29500 -m stemgnn_tpu_torch --dataset ECG_data --data_axis 16
    torchrun --nnodes 2 --node_rank 1 --nproc_per_node 8 \
        --master_addr HOST0 --master_port 29500 -m stemgnn_tpu_torch --dataset ECG_data --data_axis 16

Every rank builds its inputs itself, the same on every host: the dataset
(each host's local rank 0 synthesizes a missing one from the global lead's
seed, `dataset_file`), the split, the norm stats, the parameters and the
batches from the seed. So no rank gathers an input from another, and the
port needs nothing like the JAX package's `make_globalizer`
(stemgnn_tpu/parallel/mesh.py). Only global rank 0 writes files.

A directory the JAX package trained (its flax checkpoints) serves and
resumes as the port's own does (train/checkpoint.py):

    python -m stemgnn_tpu_torch --dataset ECG_data --train False --output_dir JAX_OUTPUT
    python -m stemgnn_tpu_torch --dataset ECG_data --resume True --epoch 50 --output_dir JAX_OUTPUT

`--init_stream threefry` draws the parameters as the JAX package's
`--init_stream threefry` does (models/initializers.py
`init_params_threefry`); the default, "torch", is the reference's draw.

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
from stemgnn_tpu_torch.data.synthetic import default_seed
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


def dataset_file(cfg) -> str:
    """The dataset's CSV, synthesized if missing: each host's local lead
    (LOCAL_RANK 0 where torchrun sets it, else the global lead) writes it
    (hosts need not share a filesystem, and `ensure_dataset` moves a whole
    file into place), every rank waits at a barrier, then every rank reads
    it. A synthesized series is drawn from the global lead's seed on every
    host (Python salts the default seed's hash in each process)."""
    seed = None
    if dist.is_initialized():
        box = [default_seed(cfg.dataset)]
        dist.broadcast_object_list(box, src=0)
        seed = box[0]
    local = os.environ.get("LOCAL_RANK")
    local_lead = int(local) == 0 if local is not None else is_lead()
    data_file = ensure_dataset(cfg.dataset, cfg.data_dir, seed) if local_lead else None
    if dist.is_initialized():
        dist.barrier()
    return data_file or ensure_dataset(cfg.dataset, cfg.data_dir, seed)


def _run(cfg):
    data_file = dataset_file(cfg)
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
