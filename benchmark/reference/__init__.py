"""The benchmark's plain reference: PyTorch only, importing nothing of the
program. :mod:`.stance` works out the standing-balance QPs from the
configuration in float64; :mod:`.qp` is an independent solver of the
force-distribution QP."""
