"""octree of hotformerloc_torch."""
