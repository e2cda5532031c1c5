"""Entry points of the port: the inference CLI (``infer``) and the
micro-batching HTTP server (``serve``), grouped by ``cli``."""
