"""Host time from a ``train_loop`` call to its first step: the program's
``train.build`` (the step bundle, the transport, the state),
``train.plan`` (the resident plan) and ``train.stage`` (its one staging
copy) spans (``train/trainer.py``), summed over the traced window and
divided by the count of ``train.plan``, one a call and so one a round in
the training cell.  Moves ``train_tokens_per_s``."""

READS = ("program spans train.build, train.plan, train.stage",)


def read(ctx):
    t = ctx["trace"]
    if t is None or not t.host_count("train.plan"):
        return None
    return sum(t.host_seconds(n) for n in
               ("train.build", "train.plan", "train.stage")) \
        / t.host_count("train.plan") * 1e3
