"""Host-side helpers of the port: metrics, submission files, timing on the card."""
