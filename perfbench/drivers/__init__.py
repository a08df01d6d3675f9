"""Window drivers, one a traffic kind: ``<kind>.py`` holds its ``Driver``."""
