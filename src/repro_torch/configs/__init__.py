"""Experiment configurations of the port (the paper's logistic regression)."""

from . import paper_logreg

__all__ = ["paper_logreg"]
