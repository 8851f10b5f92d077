"""Models over the PathSim primitives: the multi-metapath ensemble
(:mod:`.multipath`)."""
