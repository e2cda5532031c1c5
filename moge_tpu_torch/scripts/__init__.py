"""Entry points of the port: the inference CLI (``infer``), the
micro-batching HTTP server (``serve``), panorama inference
(``infer_panorama``) and the eval harness's commands (``eval_baseline``,
``infer_baseline``), grouped by ``cli``."""
