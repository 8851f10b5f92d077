"""Models over the PathSim primitives: the multi-metapath ensemble
(:mod:`.multipath`) and the Cauchy-quadrature helpers of the analytic
embedding map (:mod:`.neural`)."""
