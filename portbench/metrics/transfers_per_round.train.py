"""Host-device transfers of one training round (a refresh and
``snapshot_every`` steps): the program's ``transfers`` ledger of
``train_loop`` (staging copies in, record and checkpoint pulls out),
summed over the window's rounds and divided by their number.  Fewer
transfers mean fewer waits of the host on the card.  Moves
``train_tokens_per_s``."""

READS = ("program counter train_loop(...)['transfers']",)


def read(ctx):
    value = ctx["counters"].get("transfers_per_round")
    return None if not value else value
