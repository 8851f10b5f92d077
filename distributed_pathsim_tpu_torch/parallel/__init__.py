"""Multi-device execution: the mesh, the row-sharded chain, the ring
top-k, 2-D tiling and the multi-process rendezvous.

One process drives the whole mesh (single controller, as the JAX
package's ``shard_map`` programs do): a mesh is an ordered list of
``torch.device`` shards, and the collectives are explicit tensor moves
in that process (:mod:`.mesh`). Only across processes does
``torch.distributed`` carry data (:mod:`.multihost`).
"""
