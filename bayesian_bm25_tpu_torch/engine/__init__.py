"""Owned BM25 engine on PyTorch: host-side index build, the
frequency-split index, and the CUDA kernels of its retrieval path."""
