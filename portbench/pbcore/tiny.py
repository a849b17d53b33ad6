"""Small sizes of each cell, for rehearsing a run on the CPU and for the
harness's tests: the same drivers, references and comparisons as on the
card, at shapes a CPU runs in seconds.

    from pbcore import harness, tiny
    harness.run_cell("danube_train_dpsvrg", 7, 0.5, False, device="cpu",
                     **tiny.OVERRIDES["danube_train_dpsvrg"])
"""

from . import manifest


def _limits(traffic: str, **cpu) -> dict:
    """The cell's limits, with those that the CPU's float32 arithmetic
    reads wider than the card's set apart: its reductions run in order, so
    a float32 norm over half a million entries is off by ~1e-4 of itself
    (on the card a tree reduction is off by ~1e-7)."""
    return dict(manifest.traffic(traffic)["limits"], **cpu)


TINY_LM = {"num_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 2,
           "head_dim": 16, "d_ff": 96, "vocab_size": 2048,
           "sliding_window": 48, "rope_theta": 10000.0, "norm_eps": 1e-6,
           "tie_embeddings": False, "norm": "rmsnorm", "ffn_kind": "swiglu",
           "param_dtype": "float32"}

OVERRIDES = {
    "logreg_sweep64": {
        "config_overrides": {"dataset": {"n": 1024, "d": 64, "row_norm": 3.0,
                                         "noise": 0.2, "active": 16},
                             "num_outer": 4},
        "traffic_overrides": {"lams": [0.001, 0.01], "seeds_per_lam": 2,
                              "trace_grids": 1}},
    "danube_train_dpsvrg": {
        "config_overrides": {"model": TINY_LM, "per_node_batch": 2},
        "traffic_overrides": {"m": 4, "seq": 24,
                              "snapshot_every": 4, "snapshot_batch_mult": 2,
                              "shard_tokens": 4096,
                              "limits": _limits("train_dpsvrg",
                                                v_norm_gap=3e-4)}},
    "danube_serve_poisson": {
        "config_overrides": {"model": TINY_LM},
        "traffic_overrides": {"rate": 20.0,
                              "prompt": {"median": 24, "sigma": 0.8,
                                         "min": 4, "max": 60},
                              "new_tokens": {"min": 4, "max": 12},
                              "slots": 4, "chunk": 4, "max_len": 72,
                              "drain_s": 20, "warm_prompts": [4, 16, 60],
                              "trace_seconds": 1.0}},
}
