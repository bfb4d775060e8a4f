"""Host-side utilities: graph containers, collation, atomic I/O."""
