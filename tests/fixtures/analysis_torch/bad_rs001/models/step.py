"""BAD: tuning-knob resolution inside what a CUDA graph captures (RS001).

The knob is resolved in a helper the captured region calls: the capture
records the launches of the whole call, so the value is frozen there."""
import torch

from ..tuning import dispatch


class GraphedStep:
    def __init__(self, x):
        self.x = x
        self.graph = None
        self.out = None

    def _body(self, x):
        rows = dispatch.choose("sparse_tile_rows", n=8, default=1024)
        return x * rows

    def run(self):
        if self.graph is None:
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.out = self._body(self.x)
        self.graph.replay()
        return self.out
