"""training of hotformerloc_torch."""
