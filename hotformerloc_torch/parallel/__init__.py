"""parallel of hotformerloc_torch."""
