"""Router-side firehose pipelining: bounded update admission + coalescing.

The router's plain ``update`` path broadcasts every delta individually:
one wire round trip, one fencing epoch, one worker-side drain per
delta. Under a sustained firehose that serializes the fleet on
broadcast latency long before the O(Δ) patch math saturates. This
module gives the router the two missing pieces:

- **Bounded admission with backpressure**: updates land in a bounded
  queue; past the bound the submitter gets an immediate
  ``backpressure`` error instead of unbounded queue growth — the
  firehose's producer sees the signal and can throttle, exactly like
  query-side shed.
- **Coalescing**: a pump drains the queue and folds up to K queued
  updates into ONE broadcast (the product-rule ΔC composes, so K
  epochs become one). Record-level folding cancels add/remove pairs of
  the same edge key and concatenates node appends in order;
  within-window conflicts a single batch cannot express (the same edge
  key added twice) split the window instead of failing it. Every
  member future resolves with the group's result plus its own id.

The same cancellation semantics exist one layer down for dense-index
``DeltaBatch`` objects (:func:`~..data.delta.coalesce_deltas`), where
the K-coalesced == K-sequential property is tested bit-exactly
(tests/test_torch_delta.py).
"""

from __future__ import annotations

import dataclasses


def _edge_key(rec: dict) -> tuple:
    """Stable identity of one edge record: by id when the record uses
    ids, by dense row when it uses rows. Rows are append-only, so row
    keys stay valid across a window that also appends nodes. An edge
    addressed by id in one update and by row in another does NOT
    cancel — the merged batch would then be rejected whole by the
    delta machinery, which is why a failed coalesced broadcast falls
    back to sequential replay (core.py)."""
    rel = rec.get("rel")
    src = (
        ("id", rec["src"]) if rec.get("src") is not None
        else ("row", int(rec.get("src_row", -1)))
    )
    dst = (
        ("id", rec["dst"]) if rec.get("dst") is not None
        else ("row", int(rec.get("dst_row", -1)))
    )
    return (rel, src, dst)


@dataclasses.dataclass
class UpdateGroup:
    """One coalesced broadcast: the merged wire records plus the
    member requests whose futures it resolves."""

    members: list
    add_nodes: list
    add_edges: list
    remove_edges: list

    @property
    def merged_wire(self) -> dict:
        return {
            "op": "update",
            "add_nodes": list(self.add_nodes),
            "add_edges": list(self.add_edges),
            "remove_edges": list(self.remove_edges),
            # every router broadcast asks for the affected-row SET
            # (fencing needs it); _submit_update stamps it regardless —
            # declared here so the wire schema records the producer
            "want_rows": True,
        }


class _WindowState:
    """Running fold of one group: net edge signs + appended-id sets."""

    def __init__(self):
        self.nodes: list = []
        self.node_ids: set = set()
        # edge key → (+1 record) | (-1 record); cancelled keys removed
        self.net: dict[tuple, tuple[int, dict]] = {}

    def try_fold(self, req: dict) -> bool:
        """Fold one update's records in; False (state untouched) when
        the update conflicts with the window and must start a new
        group. Conflicts: an appended id already appended in-window, or
        an edge key transitioning add→add / remove→remove."""
        staged_nodes = []
        staged_ids = set()
        for rec in req.get("add_nodes") or ():
            key = (rec.get("type"), rec.get("id"))
            if key in self.node_ids or key in staged_ids:
                return False
            staged_ids.add(key)
            staged_nodes.append(rec)
        staged_net: dict[tuple, tuple[int, dict] | None] = {}
        for field, sign in (("add_edges", 1), ("remove_edges", -1)):
            for rec in req.get(field) or ():
                key = _edge_key(rec)
                if key in staged_net:
                    cur = staged_net[key]
                else:
                    cur = self.net.get(key)
                cur_sign = cur[0] if cur is not None else 0
                if cur_sign == sign:
                    return False
                staged_net[key] = (
                    None if cur_sign == -sign else (sign, rec)
                )
        self.nodes.extend(staged_nodes)
        self.node_ids |= staged_ids
        # commit by REPLACING the map (pure rebuild, no paired
        # insert/remove on the live table): a cancelled key simply
        # isn't carried over
        merged = {
            k: v for k, v in self.net.items() if k not in staged_net
        }
        merged.update({
            k: v for k, v in staged_net.items() if v is not None
        })
        self.net = merged
        return True

    def group(self, members: list) -> UpdateGroup:
        return UpdateGroup(
            members=members,
            add_nodes=list(self.nodes),
            add_edges=[r for s, r in self.net.values() if s > 0],
            remove_edges=[r for s, r in self.net.values() if s < 0],
        )


def coalesce_update_groups(reqs: list, max_group: int) -> list[UpdateGroup]:
    """Fold a queue drain into broadcast groups, in order: each group
    holds up to ``max_group`` conflict-free updates. Ordering within
    and across groups preserves submission order, so the sequential
    semantics every client observed before coalescing are unchanged —
    only the broadcast count shrinks."""
    groups: list[UpdateGroup] = []
    state = _WindowState()
    members: list = []

    def flush():
        nonlocal state, members
        if members:
            groups.append(state.group(members))
        state = _WindowState()
        members = []

    for req in reqs:
        if members and (
            len(members) >= max_group or not state.try_fold(req)
        ):
            flush()
        if not members and not state.try_fold(req):
            # a SELF-conflicting update (e.g. one batch adding the same
            # edge twice): pass its records through verbatim as a
            # singleton group so the workers reject it with their own
            # diagnostic — coalescing must never launder an invalid
            # update into an empty no-op broadcast
            flush()
            groups.append(UpdateGroup(
                members=[req],
                add_nodes=list(req.get("add_nodes") or ()),
                add_edges=list(req.get("add_edges") or ()),
                remove_edges=list(req.get("remove_edges") or ()),
            ))
            continue
        members.append(req)
    flush()
    return groups
