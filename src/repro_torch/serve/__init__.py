"""Serving layer of the port: the request coalescer with the estimate
cache (:mod:`repro_torch.serve.coalescer`) and the semantic-operator
planner (:mod:`repro_torch.serve.semantic`). Unlike the reference's
``serve/engine.py`` it holds no LM serving engine, so importing it pulls in
no model code."""
