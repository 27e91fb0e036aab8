"""The plain references the checks hold the program to."""
