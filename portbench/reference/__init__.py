"""Plain references that decide ``correct``: plain PyTorch, written from the
paper and the models' published descriptions.  They import nothing of the
program and take nothing it made: they work out the minibatch indices,
mixing products, step sizes, snapshots and caches again from the inputs
the harness hands to both sides."""
