import sys

if sys.argv[1:2] and sys.argv[1] in ("submit", "jobs", "watch"):
    # The service's clients, without the engines' imports.
    from .clients import main
else:
    from .cli import main

sys.exit(main())
