from antidote_tpu_torch.txn.manager import (AbortError, Transaction,
                                            TransactionManager)

__all__ = ["AbortError", "Transaction", "TransactionManager"]
