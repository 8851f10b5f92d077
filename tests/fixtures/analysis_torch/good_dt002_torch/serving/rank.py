"""A serving module that leaves selection to the pathsim primitives."""

import torch

from ..ops import pathsim


def top_rows(scores: torch.Tensor, cols, k: int):
    return pathsim.topk_from_candidate_scores(scores.cpu().numpy(), cols, k)


def ordered_labels(labels: list):
    names = list(labels)
    names.sort()
    return names


def as_list(scores: torch.Tensor):
    values = scores.tolist()
    values.sort()
    return values
