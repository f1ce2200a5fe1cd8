"""Error codes, mirroring the reference enum (include/libbz3.h:47-55)."""

BZ3_OK = 0
BZ3_ERR_OUT_OF_BOUNDS = -1
BZ3_ERR_BWT = -2
BZ3_ERR_CRC = -3
BZ3_ERR_MALFORMED_HEADER = -4
BZ3_ERR_TRUNCATED_DATA = -5
BZ3_ERR_DATA_TOO_BIG = -6
BZ3_ERR_INIT = -7
BZ3_ERR_DATA_SIZE_TOO_SMALL = -8

_MESSAGES = {
    BZ3_OK: "No error",
    BZ3_ERR_OUT_OF_BOUNDS: "Data index out of bounds",
    BZ3_ERR_BWT: "Burrows-Wheeler transform failed",
    BZ3_ERR_CRC: "CRC32 check failed",
    BZ3_ERR_MALFORMED_HEADER: "Malformed header",
    BZ3_ERR_TRUNCATED_DATA: "Truncated data",
    BZ3_ERR_DATA_TOO_BIG: "Too much data",
    BZ3_ERR_INIT: "Failed to initialize",
    BZ3_ERR_DATA_SIZE_TOO_SMALL: (
        "Size of buffer passed to the block decoder is too small"
    ),
}


def strerror(code: int) -> str:
    """Human-readable message for an error code (src/libbz3.c:512-533)."""
    return _MESSAGES.get(code, "Unknown error")


class Bz3Error(Exception):
    """Raised by the Python-level APIs on any codec failure."""

    def __init__(self, code: int, detail: str = ""):
        self.code = code
        self.detail = detail
        msg = strerror(code)
        if detail:
            msg = f"{msg}: {detail}"
        super().__init__(msg)

    def __reduce__(self):  # keeps the code across a process pool
        return type(self), (self.code, self.detail)
