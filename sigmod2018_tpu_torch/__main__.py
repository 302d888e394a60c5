from .io.repl import main

main()
