"""``setup_s``: host seconds from the process's start to the window's
start: the imports, the graph, the port's set-up and the warm-up."""


def read(run: dict) -> float | None:
    return run.get("setup_s")
