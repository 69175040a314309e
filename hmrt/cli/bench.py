"""CLI: run the B1-B5 benchmark configs (SURVEY.md C24, section 6)."""

from hmrt.bench.runner import main

if __name__ == "__main__":
    main()
