"""Parallel layouts over ``torch.distributed`` (counterpart of
serenade_tpu/parallel/).

Two execution models:

* **Collective layouts**, for training: dp (``sharding.py``, with ZeRO-1
  optimizer state), tp (``sharding.py``), cp
  (``ops/attention.py::seq_sharded_attention``), pp (``pipeline.py``), ep
  (``moe.py``) and the composed dp × tp × pp step (``composed.py``).  One
  process a rank, launched by ``torchrun`` (``mesh.maybe_init_distributed``
  reads its environment) or spawned; every collective goes through
  ``torch.distributed`` on the caller's process group (``comm.py``): NCCL
  with one card a rank, gloo on the CPU.  NCCL refuses two ranks on one
  card, so two ranks sharing a card run gloo over CUDA tensors; gloo's
  send/recv take no CUDA tensors, so the ring shift copies through the
  host there (``comm.staged_bytes`` counts the bytes).
* **Data-parallel inference**: one controller over a list of devices
  (``make_mesh(devices=...)``), each replica converting its own sub-batch
  on its own device with no collective (``api.Converter``'s
  ``data_mesh``, ``Vocoder.place_on_mesh``, the server's and the decode's
  ``--data-axis``).
"""

from serenade_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_spec,
    composed_mesh,
    data_sharding,
    make_mesh,
    maybe_init_distributed,
    replicated,
    shard_batch,
)


def __getattr__(name):
    # sharding.py reads the param bridge, which imports the models; loaded
    # on first use so that the models can import mesh.py
    if name in ("infer_param_shardings", "shard_params"):
        from serenade_tpu_torch.parallel import sharding

        return getattr(sharding, name)
    raise AttributeError(name)
