"""The reference's model families, one module each (`models.family`)."""
