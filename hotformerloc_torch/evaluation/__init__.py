"""evaluation of hotformerloc_torch."""
