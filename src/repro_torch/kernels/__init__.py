"""Hand-written Hopper kernels of the port and their plain versions.

flash_attention — blockwise online-softmax attention forward (GQA,
    causal + sliding window, strided k/v), CUDA C++ for sm_90a in
    `csrc/flash_attention.cu`: a bf16 tensor-core prefill, a bf16 split-KV
    decode with its combine, and a CUDA-core kernel for fp32; replaces the
    Pallas TPU kernel of the same name.
fleet_drift — every stream's token histogram and its Jensen-Shannon score
    against the stream's reference in one launch (buckets from a table or
    a reciprocal computed on the host, no division per token; lanes per
    row with private shared-memory counters, no atomics), CUDA C++ in
    `csrc/fleet_drift.cu`; replaces the Pallas TPU kernel of the same
    name.
pairwise_js — the (N, M) Jensen-Shannon matrix between histogram rows (a
    warp per fleet row, request rows staged in shared memory), CUDA C++
    in `csrc/pairwise_js.cu`; replaces the Pallas TPU kernel of the same
    name.
ssd_scan — the Mamba-2 SSD chunk scan of hymba's SSM heads, with the final
    state: in bf16 the chunkwise-parallel form on tensor cores (the chunks'
    own states, a short walk over the chunks, the outputs: three
    launches), in fp32 a CUDA-core kernel with a block per (batch, head)
    walking the chunks in order; CUDA C++ in `csrc/ssd_scan.cu`; replaces
    the Pallas TPU kernel of the same name.
mlstm_scan — the chunkwise stabilised mLSTM of xLSTM's matrix-memory
    blocks, with the final (C, n, m) state (a block per (batch, head) and
    32 rows of the state walking the chunks in order, the rows in shared
    memory), CUDA C++ in `csrc/mlstm_scan.cu`; replaces the Pallas TPU
    kernel of the same name.

ops.py dispatches by the tensor's device ("auto"), to the differentiable
plain forms the train step takes ("autograd"), or to the plain version
("ref"); ref.py holds the plain versions; _build.py compiles the CUDA
sources with nvcc at first use and loads them with ctypes.
"""
