"""The estimator's exact path: LSH index, adaptive prober, Chernoff bounds,
dynamic updates and the public ``build``/``estimate``/``update`` API."""
