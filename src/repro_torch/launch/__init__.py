"""Entry points of the port: the always-on NVR daemon (``launch.daemon``),
the serving launcher (``launch.serve``) and the training launcher
(``launch.train``), each a ``main(argv)`` run as ``python -m
repro_torch.launch.<name>``."""
