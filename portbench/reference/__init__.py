"""The plain references that decide ``correct``; they import nothing of the program."""
