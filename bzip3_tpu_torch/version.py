"""Version of the bzip3_tpu_torch port.

Format-compatible with BZ3v1 streams produced by reference bzip3 1.5.2.
"""

__version__ = "0.1.0"
