"""Plain references of the benchmark's configurations, one module each,
named by a configuration's ``reference`` key, each with
``from_graph(g)`` over the generator's arrays. They import NumPy alone:
nothing of the port, nothing of JAX."""
