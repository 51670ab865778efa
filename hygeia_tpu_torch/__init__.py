"""hygeia_tpu_torch: the PyTorch and CUDA port of hygeia_tpu.

A second package beside the JAX one, with the same layout
(``hygeia_tpu/X/y.py`` has its counterpart at ``hygeia_tpu_torch/X/y.py``).
It imports torch and never jax or pandas; the JAX package is the reference
that the port's tests hold it against.

Conventions:

- Plain functions on tensors, with an explicit ``device`` and an explicit
  ``torch.Generator`` for every draw.
- JAX's ``vmap`` over seeds is a leading unit axis U, written out: every
  per-site op runs once for all U units.
- No fallback: a CUDA tensor goes through the hand-written kernel or the
  call raises. The plain PyTorch versions serve CPU tensors (the tests).

Subpackages
-----------
ops           Distributions, hazard tables, emission tables, resampling, and
              the CUDA optimal resampler (``csrc/optimal_resampling.cu``).
single_group  Single-group model and online engine (regime probabilities
              and theta), its blocked form, the ``estimate_parameters_and_regimes``
              runner.
two_group     Case/control particle filter, backward simulation, INFER runner.
pipeline      The two-group pipeline (``run --two_group``) and numpy ports of
              its host stages: preprocess, segments, aggregate, DMP calling.
utils         numpy+gzip readers and writers of the reference file formats.
"""

__version__ = "0.1.0"
