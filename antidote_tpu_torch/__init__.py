"""antidote_tpu_torch — the PyTorch/CUDA port of antidote_tpu.

A transactional CRDT store whose per-key state lives in device tensors:
op-based CRDTs, ClockSI snapshot transactions, per-key op rings folded by
batched device kernels, and dense vector clocks.  Entry points take a
``device`` ("cuda" by default); the materializer's hot loops are
hand-written Hopper kernels (``csrc/materializer.cu``) with plain PyTorch
versions for CPU tensors.  The JAX package ``antidote_tpu`` is the
reference this package is tested against; nothing here imports it.
"""

from antidote_tpu_torch.config import AntidoteConfig

__version__ = "0.1.0"
__all__ = ["AntidoteConfig", "__version__"]
