"""losses of hotformerloc_torch."""
