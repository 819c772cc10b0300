"""Cost models of the port, and its profiler spans (:mod:`.spans`)."""
