"""Distributed layer: document-axis sharding over a mesh of devices.

Counterpart of ``bayesian_bm25_tpu/parallel``. One process drives the
mesh (``sharded.ShardMesh``): the doc-major term table and the split
index are cut along the document axis, one part per shard, queries are
replicated, each shard's scoring, leader selection and merge run as
launches on its device, and the cross-shard merge and the corpus
statistics are host-ordered collectives on the merge device.
"""
