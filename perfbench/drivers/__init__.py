"""One module per entry point of the port that a configuration can name
(its ``driver``).  Each gives ``setup``, ``instrument``, ``window``,
``readings``, ``teardown`` and ``check`` (see :mod:`perfbench.bench`)."""
