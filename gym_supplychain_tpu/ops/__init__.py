"""Hand-written GPU kernels (Pallas, Triton route).

The step semantics live in ``core/`` as plain jax.numpy under ``lax.scan``;
on a GPU each env step there is a chain of small XLA kernels.  The collect
kernels here run whole episodes in one program per lane tile instead
(``supplychain_pallas``, ``beergame_pallas``), replaying episode tables.
``reference`` holds the table draws and the scan-engine reference they are
compared with, so the XLA-vs-Pallas tradeoff stays measured rather than
assumed.
"""
