"""Hand-written Hopper kernels of the port and their plain versions.

flash_attention — blockwise online-softmax attention forward (GQA,
    causal + sliding window, strided k/v), CUDA C++ for sm_90a in
    `csrc/flash_attention.cu`; replaces the Pallas TPU kernel of the same
    name.

ops.py dispatches by the tensor's device ("auto") or to the plain version
("ref"); ref.py holds the plain versions; _build.py compiles the CUDA
sources with nvcc at first use and loads them with ctypes.
"""
