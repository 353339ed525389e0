"""Checksums of the port (``crc32c``)."""
