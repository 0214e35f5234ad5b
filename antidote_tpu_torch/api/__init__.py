from antidote_tpu_torch.api.node import AbortError, AntidoteNode

__all__ = ["AntidoteNode", "AbortError"]
