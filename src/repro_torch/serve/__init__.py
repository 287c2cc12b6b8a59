"""Point-cloud serving."""
