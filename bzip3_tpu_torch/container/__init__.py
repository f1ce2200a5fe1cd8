"""BZ3v1 containers: size bounds, the frame API and the stream format."""
