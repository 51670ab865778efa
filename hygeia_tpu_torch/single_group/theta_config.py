"""Block geometry of the blocked theta stage, the one place it lives: read
by single_group/blocked.py and by the pipeline's per-chromosome and batched
theta stages. The JAX package's constants (hygeia_tpu/single_group/
theta_config.py), chosen there on a TPU; copied, not imported."""

THETA_BLOCK_SIZE = 49152
THETA_HALO = 4096
THETA_WARMUP_SITES = 65536
# Chromosomes below this length keep the sequential / t_limit-batched path.
THETA_BLOCK_THRESHOLD = 150_000
