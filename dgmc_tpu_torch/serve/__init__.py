"""Online matching: corpus index, bucket router, match engine."""
