"""Host-side helpers of the CLI, the server, the panorama and the eval
harness: codecs (``io``, ``exr``), numpy geometry (``geometry_numpy``), mesh
export (``mesh``), colorization (``vis``), the threaded data pipeline
(``pipeline``) and timing and nested-dict tools (``tools``). Copies of what
the port needs from the JAX package's ``utils``; cv2, PIL and matplotlib are
imported inside the functions that use them, so the package imports
without them."""
