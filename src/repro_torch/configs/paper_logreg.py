"""The paper's own model: l1-regularized logistic regression (Eq. 26).

Not a transformer — a convex finite-sum problem over m = 8 nodes, trained
with DPSVRG vs. DSPG in the faithful reproduction benchmarks.  This module
records the paper's experiment hyper-parameters in one place.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class PaperLogRegConfig:
    num_nodes: int = 8
    alpha: float = 0.01          # paper Section V-B
    lam: float = 0.01            # l1 coefficient
    lambdas: tuple = (0.001, 0.01, 0.1)   # Fig. 4 sweep
    bs: tuple = (1, 3, 7, 50)    # Fig. 5 connectivity sweep
    datasets: tuple = ("mnist_like", "cifar10_like", "adult_like",
                       "covertype_like")
    beta: float = 1.07           # K_s growth base
    n0: int = 8


CONFIG = PaperLogRegConfig()
