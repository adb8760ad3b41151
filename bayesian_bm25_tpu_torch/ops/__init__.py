"""Math primitives and the Bayesian probability transform on tensors."""
