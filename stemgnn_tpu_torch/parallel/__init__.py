"""Multi-device training over torch.distributed (stemgnn_tpu/parallel): the
('data', 'graph') mesh and its collectives (`mesh`), the node-sharded stretch
path (`sparse_shard`), the dense path's node partition (`dense_shard`) and
`--use_ring` (`ring`), the sharded train and eval steps (`train`) and a CPU
dryrun of them across processes (`dryrun`)."""
