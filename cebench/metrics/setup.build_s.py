"""Seconds of ``estimator.build`` (LSH projection, Alg. 7, the sorted-CSR
layout; with PQ, k-means), host clock around the call, synchronised."""


def read(ctx):
    return ctx.build_s
