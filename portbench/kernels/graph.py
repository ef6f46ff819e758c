"""The Chebyshev graph conv's kernels (`ops/cuda_graph.py`,
`csrc/graph.cu`): the f32 arm on 3xTF32 and the bf16 arm. No bound is
counted yet: their kernels are named so that `library_ms` leaves them
out."""

KERNELS = r"cheb_graph_conv_\w+_kernel"
