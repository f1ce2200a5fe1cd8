"""Block framing of the BZ3v1 format."""
