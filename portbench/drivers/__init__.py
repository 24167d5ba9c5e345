"""One driver a kind of configuration (``serve``, ``train``), found by
the ``kind`` of a configuration file: ``drivers/<kind>.py``'s
``run(ctx) -> records``."""
