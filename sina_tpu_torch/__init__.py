"""sina_tpu_torch: the PyTorch/CUDA port of sina-tpu.

SINA (the SILVA Incremental Aligner) on an NVIDIA GPU — batched k-mer
family search with the turn check, the profile and graph (mseq)
alignment engines with their tracebacks, NAST finishing, search + LCA
classification — with the JAX package sina_tpu as its reference.
Device kernels are hand-written CUDA (csrc/); every kernel has a plain
PyTorch version beside it, which CPU tensors use.  The package owns
its host code (FASTA/CSV I/O, the reference database, the k-mer index
builder, the native C++ library): it imports nothing of sina_tpu.
"""

__version__ = "0.1.0"
