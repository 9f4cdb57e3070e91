"""Entry points of the port: the always-on NVR daemon (``launch.daemon``)
and the serving launcher (``launch.serve``), each a ``main(argv)`` run as
``python -m repro_torch.launch.<name>``."""
