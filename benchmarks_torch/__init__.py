"""The benchmark harness of ``benchmarks/`` run through the PyTorch port.

``benchmarks/`` imports the JAX package; this directory holds what the
port needs to run it without JAX:

  * ``_alias``          — the import alias (``bayesian_bm25_tpu[.sub]`` to
                          ``bayesian_bm25_tpu_torch[.sub]``, and
                          ``benchmarks.hybrid_beir`` to this directory's
                          copy) and the port's default device for scripts
                          that name none;
  * ``hybrid_beir``     — the copy of ``benchmarks/hybrid_beir.py`` whose
                          dense product and devices are the port's;
  * ``sharded_scaling`` — the counterpart of
                          ``benchmarks/sharded_scaling.py``: its shards
                          share one device;
  * ``scalability``, ``wand_upper_bound`` — copies of the scripts that
                          read the index's arrays as numpy, reading the
                          port's tensors;
  * ``data``            — the synthetic corpora drawn as numpy 2.0 draws
                          them;
  * ``results/``        — the gate studies' artifacts from the card.

``scripts/run_benchmarks_torch.py`` runs it all;
``scripts/record_jax_benchmarks.py`` records the JAX package's output
that it is compared with.
"""

# benchmarks/*.py that run on the port under the alias (unchanged, or as
# their copy here), and whose JAX output is recorded where its run ends in
# time and prints more than timings.
SCRIPTS = (
    "base_rate", "benchmark", "bmw_upper_bound", "calibration",
    "convergence", "gating_functions", "learnable_weights",
    "multi_head_attention", "neural_calibration", "scalability",
    "wand_upper_bound", "weighted_fusion",
)
