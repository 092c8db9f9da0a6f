"""Scripts that measure the port's kernels on a card (run with ``python3 -m``)."""
