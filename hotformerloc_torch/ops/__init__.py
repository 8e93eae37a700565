"""ops of hotformerloc_torch."""
