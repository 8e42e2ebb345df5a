"""Cell runners, one a traffic kind: `<kind>.py` defines `Cell`."""
