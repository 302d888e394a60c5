"""sigmod2018_tpu_torch — the PyTorch + CUDA port of `sigmod2018_tpu`.

The same multi-way equi-join engine for the SIGMOD-2018 contest protocol
(bit-exact uint64 checksums), written in PyTorch for one NVIDIA Hopper
card.  Its layout mirrors the reference package module by module:

- storage/   columnar uint64 relations + exact per-column statistics
- frontend/  query text -> typed IR
- planner/   selectivity propagation + DP join enumeration
- ops/       device operators on torch tensors; `ms_join.staircase_counts`
             launches the hand-written CUDA kernel in csrc/stair_counts.cu
- engine/    the operator-granular query executor (TorchEngine)
- io/        the stdin/stdout protocol driver (`python -m sigmod2018_tpu_torch`)
- tools/     the relation generator of the benchmark workloads

uint64 columns travel as int64 bit patterns (`ndarray.view(np.int64)`):
unsigned order is the signed order of `x ^ (1 << 63)` (ops/u64.py), and
int64 wrap-around sums are bit-identical to uint64 sums mod 2^64.
"""

__version__ = "0.1.0"
