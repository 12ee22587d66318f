"""The sequential Python oracle (a copy of the reference's ``core/ref``)."""
