"""BAD: a knob resolved inside a function make_graphed_callables
captures (RS001)."""
import torch

from ..tuning import dispatch


def _scale(x):
    width = dispatch.choose("rect_target_units", n=8, default=512)
    return x * width


def graphed(sample):
    return torch.cuda.make_graphed_callables(_scale, (sample,))
