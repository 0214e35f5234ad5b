"""Map CRDTs: map_go (grow-only) and map_rr (recursive reset-remove).

Composites over the flat store rather than device types: each map field
lives at a derived sub-key bound to its nested CRDT type, and field
membership is itself a CRDT —

  * map_go: grow-only membership (set_go on field ids)
  * map_rr: add-wins membership (set_aw): a remove deletes the field
    unless a concurrent update re-adds it, and resets the nested state
    where the nested type supports reset.

Expansion happens in the transaction layer, so nested effects certify and
apply exactly like top-level updates; the map value is assembled at read
time from membership and nested reads.

For nested types without a reset operation (e.g. counter_pn) a map_rr
remove hides the field through membership but cannot clear the nested
state: a concurrent re-add revives the old value rather than a reset one.
"""

from __future__ import annotations

from typing import Any, List, Tuple

from antidote_tpu_torch.crdt.base import CRDTType

#: map type -> membership set type
MAP_MEMBERSHIP = {"map_rr": "set_aw", "map_go": "set_go"}

_FIELD_NS = "\x00mapfield"
_MEMBER_NS = "\x00mapmember"


def member_key(parent_key) -> tuple:
    return (_MEMBER_NS, parent_key)


def field_key(parent_key, field, ftype: str) -> tuple:
    return (_FIELD_NS, parent_key, field, ftype)


def _reset_ops(ftype: str, current_value) -> List[tuple]:
    """The nested reset a map_rr removal issues, where the type has one."""
    if ftype in ("set_aw", "set_rw"):
        if current_value:
            return [("remove_all", list(current_value))]
        return []
    if ftype == "counter_fat":
        return [("reset", None)]
    if ftype in ("flag_ew", "flag_dw"):
        return [("disable", None)]
    return []  # no reset support (counter_pn, registers, rga, ...)


class _MapBase(CRDTType):
    """Composite marker type: no device table; the transaction layer
    expands its updates and assembles its reads."""

    composite = True

    def state_spec(self, cfg):
        raise TypeError(f"{self.name} is a composite type (no device table)")

    def downstream(self, op, state, blobs, cfg):
        raise TypeError(f"{self.name} is expanded by the transaction layer")

    def apply(self, cfg, state, eff_a, eff_b, commit_vc, origin_dc):
        raise TypeError(f"{self.name} is expanded by the transaction layer")

    def value(self, state, blobs, cfg):
        raise TypeError(f"{self.name} is assembled by the transaction layer")

    def is_operation(self, op):
        kind = op[0]
        if kind == "update":
            from antidote_tpu_torch.crdt import get_type, is_type

            try:
                items = op[1].items() if isinstance(op[1], dict) else op[1]
                return all(is_type(ft) and get_type(ft).is_operation(fop)
                           for (_f, ft), fop in items)
            except Exception:
                # a malformed update (not a field list) is not an operation
                return False
        return self.name == "map_rr" and kind in ("remove", "remove_all")


class MapGO(_MapBase):
    name = "map_go"
    type_id = 12


class MapRR(_MapBase):
    name = "map_rr"
    type_id = 13


def expand_update(key, map_type: str, bucket: str, op, read_field_value
                  ) -> List[Tuple[Any, str, str, tuple]]:
    """Expand one map op into flat (key, type, bucket, op) updates.

    ``read_field_value(fkey, ftype)`` returns a nested field's current
    value (for the resets of a removal)."""
    memb_type = MAP_MEMBERSHIP[map_type]
    kind = op[0]
    out: List[Tuple[Any, str, str, tuple]] = []
    if kind == "update":
        items = op[1].items() if isinstance(op[1], dict) else op[1]
        fields = [(f, ft) for (f, ft), _ in items]
        out.append((member_key(key), memb_type, bucket,
                    ("add_all", [list(x) for x in fields])))
        for (f, ft), fop in items:
            out.append((field_key(key, f, ft), ft, bucket, fop))
        return out
    assert map_type == "map_rr", f"{map_type} does not support {kind}"
    fields = op[1] if kind == "remove_all" else [op[1]]
    out.append((member_key(key), memb_type, bucket,
                ("remove_all", [list(x) for x in fields])))
    for f, ft in fields:
        fk = field_key(key, f, ft)
        for rop in _reset_ops(ft, read_field_value(fk, ft)):
            out.append((fk, ft, bucket, rop))
    return out


def assemble(objects, read) -> List[dict]:
    """Map values for ``objects`` [(key, map type, bucket)], batched per
    nesting level: ONE ``read`` of every map's membership, then ONE of all
    their fields (nested maps recurse through ``read``, so reads scale
    with the nesting depth, not with the number of maps).  ``read(objs)``
    returns the values of flat or composite objects."""
    membs = read([(member_key(key), MAP_MEMBERSHIP[t], bucket)
                  for key, t, bucket in objects])
    field_objs, spans = [], []
    for (key, _t, bucket), memb in zip(objects, membs):
        fields = [tuple(x) for x in memb]
        spans.append((len(field_objs), fields))
        field_objs.extend((field_key(key, f, ft), ft, bucket)
                          for f, ft in fields)
    nested = read(field_objs) if field_objs else []
    return [{(f, ft): nested[base + j] for j, (f, ft) in enumerate(fields)}
            for base, fields in spans]
