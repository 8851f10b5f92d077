"""Models over the PathSim primitives: the multi-metapath ensemble
(:mod:`.multipath`), NeuralPathSim — the Cauchy-quadrature index and the
two-tower trainer (:mod:`.neural`) — and flax's msgpack checkpoint
encoding without flax (:mod:`.flax_msgpack`)."""
