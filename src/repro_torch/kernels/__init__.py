"""Hand-written Hopper kernels of the port and their plain versions.

flash_attention — blockwise online-softmax attention forward (GQA,
    causal + sliding window, strided k/v), CUDA C++ for sm_90a in
    `csrc/flash_attention.cu`; replaces the Pallas TPU kernel of the same
    name.
fleet_drift — every stream's token histogram and its Jensen-Shannon score
    against the stream's reference in one launch (a warp per stream,
    shared-memory integer counts), CUDA C++ in `csrc/fleet_drift.cu`;
    replaces the Pallas TPU kernel of the same name.
pairwise_js — the (N, M) Jensen-Shannon matrix between histogram rows (a
    warp per fleet row, request rows staged in shared memory), CUDA C++
    in `csrc/pairwise_js.cu`; replaces the Pallas TPU kernel of the same
    name.

ops.py dispatches by the tensor's device ("auto") or to the plain version
("ref"); ref.py holds the plain versions; _build.py compiles the CUDA
sources with nvcc at first use and loads them with ctypes.
"""
