"""The latent attention's kernels (`ops/cuda_attention.py`,
`csrc/attention.cu`). No bound is counted yet: their kernels are named so
that `library_ms` leaves them out."""

KERNELS = r"attention_(fwd|bwd)_kernel"
