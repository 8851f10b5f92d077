"""GOOD: the knob is resolved before the capture and handed in; what the
capture runs reads only the value."""
import torch

from ..tuning import dispatch


class GraphedStep:
    def __init__(self, x):
        self.x = x
        self.rows = dispatch.choose("sparse_tile_rows", n=8, default=1024)
        self.graph = None
        self.out = None

    def _body(self, x, rows):
        return x * rows

    def run(self):
        if self.graph is None:
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.out = self._body(self.x, self.rows)
        self.graph.replay()
        return self.out


def _scale(x):
    return x * 2


def graphed(sample):
    return torch.cuda.make_graphed_callables(_scale, (sample,))
