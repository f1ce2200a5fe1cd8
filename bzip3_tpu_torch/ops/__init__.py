"""Stage codecs: host passes (``host``), device stages (``device``) and
the native build (``build``)."""
