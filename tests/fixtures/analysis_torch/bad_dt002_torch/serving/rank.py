"""A serving module that selects its own top-k on the card."""

import torch


def top_rows(scores: torch.Tensor, k: int):
    return torch.topk(scores, k, dim=1)


def order_by_score(rows, k: int):
    scores = torch.as_tensor(rows)
    order = torch.argsort(scores, descending=True)
    return order[:k]


def best_first(rows):
    scores = torch.as_tensor(rows).double()
    return scores.sort(descending=True)
