"""Inputs made on the device from the seed, in a few large calls."""

from __future__ import annotations

import torch


def generator(seed: int, device, salt: int = 0) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + salt) % (2**63 - 1))
    return gen


def classification(spec: dict, m: int, seed: int, device):
    """The paper's Table I geometry with a synthetic stand-in (the repo's
    ``make_paper_dataset`` recipe, drawn on the device): rows of norm
    ``row_norm``, labels from a sparse teacher with ``active`` nonzero
    weights plus Gaussian noise, split evenly over m nodes (the rows are
    independent, so node i holds rows i*n/m .. (i+1)*n/m - 1).
    -> {"features": (m, n/m, d) float32, "labels": (m, n/m) float32}."""
    n, d = spec["n"], spec["d"]
    gen = generator(seed, device, salt=1)
    teacher = torch.zeros(d, device=device)
    active = torch.randperm(d, generator=gen, device=device)[:spec["active"]]
    teacher[active] = torch.randn(spec["active"], generator=gen,
                                  device=device)
    x = torch.randn((n, d), generator=gen, device=device)
    x *= spec["row_norm"] / torch.linalg.vector_norm(x, dim=1, keepdim=True)
    raw = x @ teacher
    raw *= 3.0 / raw.std()
    logits = raw + spec["noise"] * torch.randn(n, generator=gen,
                                               device=device)
    y = (logits > 0).to(torch.float32)
    n_i = n // m
    return {"features": x[:m * n_i].reshape(m, n_i, d).contiguous(),
            "labels": y[:m * n_i].reshape(m, n_i).contiguous()}
