"""The JAX package's four examples (``examples/`` at the repository's root)
on the port, each run as ``python -m ics_tpu_torch.examples.<name>``:

- ``deblur_cases``: the reference's experiment cases through ``deblur_module``;
- ``chroma_denoise``: chromatic-noise removal with the RGB TV norms;
- ``hsv_color_balance``: the HSV colour-balance workflow;
- ``shard_deblur``: the full-frame solves split by rows over N ranks.

Each takes the arguments of its JAX twin plus ``--device`` (default
``cuda``; ``cpu`` runs it without a GPU) and ``--reference DIR``, the
directory of the reference's images that the default inputs come from
(./img by default, the JAX examples' other source).  Any TIFF path works
as the input too, which is what a host without PIL reads.
"""
