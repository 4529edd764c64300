"""One module a program entry (its ``Client``); a traffic file names it."""
