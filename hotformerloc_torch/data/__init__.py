"""Host data pipeline of hotformerloc_torch (numpy only)."""
