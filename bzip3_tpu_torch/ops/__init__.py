"""Stage codecs: the executable spec (``ref``), host passes (``host``),
device stages (``device``), the host C++ codec (``native``) and the
native build (``build``)."""
