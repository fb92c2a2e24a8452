"""Small format helpers of the port."""
