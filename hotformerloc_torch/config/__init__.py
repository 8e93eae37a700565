"""Train and model config parsing of hotformerloc_torch."""
