"""Pre/post-commit hooks per bucket.

A pre-commit hook receives ``(key, type_name, op)`` and returns a possibly
transformed ``(key, type_name, op)``; raising aborts the transaction.
Post-commit hooks observe the committed update; failures are logged, not
fatal (reference: post-commit hook errors only count an error metric).
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Tuple

logger = logging.getLogger(__name__)

Hook = Callable[[Tuple], Tuple]


class HookRegistry:
    def __init__(self):
        self._pre: Dict[str, Hook] = {}
        self._post: Dict[str, Hook] = {}

    def register_pre_hook(self, bucket: str, fn: Hook) -> None:
        self._pre[bucket] = fn

    def register_post_hook(self, bucket: str, fn: Hook) -> None:
        self._post[bucket] = fn

    def unregister_hook(self, kind: str, bucket: str) -> None:
        (self._pre if kind == "pre_commit" else self._post).pop(bucket, None)

    def execute_pre_commit_hook(self, key, type_name, bucket, op):
        fn = self._pre.get(bucket)
        if fn is None:
            return key, type_name, op
        return fn((key, type_name, op))

    def execute_post_commit_hook(self, key, type_name, bucket, op) -> None:
        fn = self._post.get(bucket)
        if fn is None:
            return
        try:
            fn((key, type_name, op))
        except Exception:  # post-commit failures are non-fatal
            logger.exception("post-commit hook failed for bucket %s", bucket)
