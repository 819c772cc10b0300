"""Serving layer of the port: the request coalescer with the estimate
cache (:mod:`repro_torch.serve.coalescer`), the semantic-operator planner
(:mod:`repro_torch.serve.semantic`, local or sharded), and the LM serving
engine (:mod:`repro_torch.serve.engine`) with its step factories
(:mod:`repro_torch.serve.step`). The reference keeps the coalescer and the
engine in one ``serve/engine.py``; here they are separate modules, so the
estimator's serving path imports no model code."""
