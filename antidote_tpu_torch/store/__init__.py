from antidote_tpu_torch.store.kv import KVStore
from antidote_tpu_torch.store.typed_table import TypedTable

__all__ = ["KVStore", "TypedTable"]
