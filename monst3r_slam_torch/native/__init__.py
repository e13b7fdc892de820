"""Native (C++) host components of the port, loaded with ctypes."""
