"""Host-side numpy helpers of the inference CLI and the server: map codecs
(``io``, ``exr``), pixel-grid geometry (``geometry_numpy``), mesh export
(``mesh``) and colorization (``vis``). Copies of what the port needs from the
JAX package's ``utils``; cv2, PIL and matplotlib are imported inside the
functions that use them, so the package imports without them."""
