"""PyTorch + CUDA port of the JAX workload beside it in this repository.

The JAX package is the reference and stays as it is; this package mirrors
its layout (``models/``, ``ops/``, ``parallel/``, ``data/``, ``train/``,
``obs/``, ``utils/``) and keeps its tensor layouts at every public
function, so the same inputs can be fed to both and compared. Slice 1
ports the serving path: the paged KV cache, the continuous batcher and an
HTTP server, with the paged-decode attention kernels written by hand in
CUDA C++ for Hopper (``csrc/paged_decode.cu``). Slice 2 ports training on
one GPU: the training forward, the clipped-AdamW step, the token loader
and the checkpointing trainer, with flash attention forward and backward
in CUDA C++ (``csrc/flash_attention.cu``). Slice 6 completes the serving
replica: int8 weights, speculative decoding with the int8 self-draft,
and the reference server's HTTP surface (SSE streaming, live migration
by ``/export`` and ``/adopt``, request tracing). Slice 7 adds the MoE
family, the goodput ledger and asynchronous checkpoints; slice 8 training
over a process group's ranks: FSDP (ZeRO-3) and sequence parallelism
(ring attention, Ulysses) over ``torch.distributed`` (``parallel/``).
Slice 11 adds ``gpu/``, the GPU twins of the JAX package's ``tpu/`` (node
facts from GPU Feature Discovery, the upgrade grouper and deletion
filter, a scheduler that places one rank per GPU), and tensor-parallel
decoding (``models/generate.py:make_tp_generate``). Slice 13 adds the
serving tier (``serving/``: the replica pool, the request router, the
autoscaler); slice 14 the router binary in front of replicas
(``router.py``) with its apiserver client (``core/liveclient.py``) and
the capacity market that trades a training slice to serving and back
(``market/``).

The package imports ``torch``, ``numpy`` and the standard library only.
Entry points run on ``device="cuda"`` unless the caller asks for the CPU,
where every kernel wrapper takes its plain PyTorch version.
"""

__version__ = "0.1.0"
