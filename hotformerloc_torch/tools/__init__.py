"""tools of hotformerloc_torch."""
