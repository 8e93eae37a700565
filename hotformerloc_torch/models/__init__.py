"""models of hotformerloc_torch."""
