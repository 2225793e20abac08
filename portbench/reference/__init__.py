"""The plain reference that decides a run's `correct`.

A frozen copy of the port's plain path (its CPU route) as it stood when
the benchmark was defined: the same stages in the same order, with every
kernel (K1-K3, L1, L2, the WHILE nodes) replaced by the plain version it
is held to. It imports nothing of the port or of the JAX package, runs on
any device and dtype (float64 on the host when it judges a run), and is
handed the same inputs as the port. Counters record the data-dependent
work that the kernels' roofline bounds count: `prior.LM_RUNS`,
`tracking.ASSIGNMENTS`, `ops.hungarian.PLAIN_SEARCH_STEPS`.
"""
